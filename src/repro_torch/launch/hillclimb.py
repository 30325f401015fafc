"""Hill-climbing driver over the dry run (port of
``repro.launch.hillclimb``): hypothesis -> change -> re-trace -> re-count,
on the dominant roofline term of a chosen (arch x shape) pair.

Each named VARIANT is a concrete change (sharding rule, microbatch count,
grad-accumulation dtype, remat, optimizer-moment dtype, MoE dispatch
groups) with the hypothesis recorded next to it; the names, hypotheses and
keywords are the reference's. Results land in
``artifacts/hillclimb_torch/<arch>_<shape>.json``; a variant that raises
is recorded with its error and the run goes on.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --arch stablelm-3b --shape train_4k [--only baseline no_fsdp]

:func:`measure` traces the full-depth step once on fake tensors
(:func:`repro_torch.launch.dryrun.trace_case`: ``FakeTensorMode`` under
``StepCounter``), so the reference's two shallow unrolled compiles and
their linear extrapolation have no counterpart. It reports ``trace_s``
(the host's tracing seconds, where the reference has ``compile_s``),
``temp_gib`` (an estimate: the whole step's peak live bytes of the plain
ops traced unsharded, ``temp_gib_is``), ``args_gib`` (exact per device,
from the partition specs) and the roofline terms against H100 data-sheet
peaks. A PyTorch trace sees no collectives, so the collective term is
None with its reason: the hypotheses about collectives cannot be tested
here, only their memory and compute sides. Nothing here runs on a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch

from repro_torch import configs as cfg_lib
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh

# name -> (hypothesis, build_case kwargs)
TRAIN_VARIANTS = {
    "baseline": (
        "paper-faithful baseline: FSDP over data, f32 grad accumulation, "
        "microbatch=4, remat", {}),
    "micro1": (
        "one microbatch: weights gathered once per fwd+bwd instead of 4x -> "
        "collective term ~/3, memory term up (activations live longer)",
        dict(microbatch=1)),
    "micro8": (
        "more microbatches: lower activation memory, but 8x weight regathers "
        "-> collective term up (expected regression, bounds the knob)",
        dict(microbatch=8)),
    "grad_bf16": (
        "accumulate/all-reduce grads in bf16: halves the gradient collective "
        "bytes at the cost of summation precision",
        dict(grad_acc_dtype=torch.bfloat16)),
    "micro1_grad_bf16": (
        "combine the two collective wins",
        dict(microbatch=1, grad_acc_dtype=torch.bfloat16)),
    "no_fsdp": (
        "replicate weights over 'data' (no FSDP): removes per-layer weight "
        "all-gathers entirely; HBM must absorb full weights + opt state",
        dict(extra_rules={"embed": None})),
    "no_remat": (
        "disable activation checkpointing: compute term -1/3 (no recompute), "
        "memory term up",
        dict(remat=False)),
    "experts_f_shard": (
        "MoE only: shard expert hidden dim F over 'data' instead of the "
        "expert D dim: expert GEMMs become reduce-scatter-shaped, dispatch "
        "buffer (E,C,D) stops being regathered per microbatch",
        dict(extra_rules={"moe_d": None, "moe_f": "data"})),
    "moe_grouped": (
        "MoE: dispatch in 16 data-aligned groups — routing argsort/scatter "
        "stay shard-local so the global token all-gather disappears; only "
        "the (G,E,C,D) x (E,D,F) expert GEMM crosses the mesh",
        dict(moe_groups=16)),
    "moe_grouped_micro1": (
        "grouped dispatch + single microbatch (combine the two wins)",
        dict(moe_groups=16, microbatch=1)),
    "adam_bf16_moments": (
        "bf16 Adam moments: optimizer state HBM and its read/write traffic "
        "halve; fp32 update math preserved — targets the memory term that "
        "no sharding variant moved",
        dict(moment_dtype=torch.bfloat16)),
    "best_combo": (
        "bf16 moments + grouped dispatch + micro8 (lowest temp) together",
        dict(moment_dtype=torch.bfloat16, moe_groups=16, microbatch=8,
             grad_acc_dtype=torch.bfloat16)),
}

DECODE_VARIANTS = {
    "baseline": ("baseline: cache head_dim sharded over 'model'", {}),
    "cache_seq_model": (
        "shard the cache SEQUENCE dim over 'model' instead of head_dim: "
        "avoids the GQA reshape resharding (involuntary full remat warning); "
        "softmax reduces over the sharded axis with an all-reduce",
        dict(extra_rules={"hd": None, "seq": "model"})),
    "cache_replicated_hd": (
        "replicate head_dim, shard only batch: no resharding at all, "
        "memory term up by model-axis factor",
        dict(extra_rules={"hd": None})),
}

PREFILL_VARIANTS = {
    "baseline": ("baseline rules", {}),
    "experts_2d": (
        "shard MoE expert FFN hidden dim over 'data' as well (2D expert "
        "sharding): halves dispatch-buffer memory per device, adds "
        "reduce-scatter inside each expert GEMM",
        dict(extra_rules={"mlp": "data"})),
    "no_fsdp": (
        "replicate non-expert weights over 'data': fewer gathers on the "
        "attention path", dict(extra_rules={"embed": None})),
    "experts_f_shard": (
        "MoE: shard expert hidden dim F over 'data' instead of expert D",
        dict(extra_rules={"moe_d": None, "moe_f": "data"})),
    "moe_grouped": (
        "MoE: 16 data-aligned dispatch groups — shard-local routing, "
        "no global token all-gather",
        dict(moe_groups=16)),
}


def variants_for(mode: str):
    return {"train": TRAIN_VARIANTS, "decode": DECODE_VARIANTS,
            "prefill": PREFILL_VARIANTS}[mode]


def measure(arch: str, shape: str, mesh, **kw) -> dict:
    """One variant: the full-depth step traced once on fake tensors."""
    case = specs_lib.build_case(arch, shape, mesh, **kw)
    counter, t_trace, args_b, _, roof = dryrun.trace_case(case, mesh)
    return {
        "trace_s": round(t_trace, 1),
        "temp_gib": counter.peak_live_bytes / 2**30,
        "temp_gib_is": dryrun.TEMP_ESTIMATE,
        "args_gib": args_b / 2**30,
        **roof.as_dict(),
    }


def hillclimb(arch: str, shape: str, out_dir="artifacts/hillclimb_torch",
              only=None) -> dict:
    mode = cfg_lib.get_shape(shape).mode
    mesh = make_production_mesh()
    log = {"arch": arch, "shape": shape, "mesh": "16x16", "iterations": []}
    for name, (hypothesis, kw) in variants_for(mode).items():
        if only and name not in only:
            continue
        print(f"--- {arch} x {shape} [{name}]")
        print(f"    hypothesis: {hypothesis}")
        try:
            m = measure(arch, shape, mesh, **kw)
        except Exception as e:  # noqa: BLE001: recorded, the run goes on
            m = {"error": f"{type(e).__name__}: {e}"}
        log["iterations"].append({"variant": name, "hypothesis": hypothesis,
                                  **m})
        if "error" in m:
            print(f"    ERROR {m['error']}")
        else:
            print(f"    compute {m['t_compute_s']:.3e}s  memory "
                  f"{m['t_memory_s']:.3e}s  collectives not counted  args "
                  f"{m['args_gib']:.2f} GiB  temp (estimate) "
                  f"{m['temp_gib']:.1f} GiB -> {m['bottleneck']}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}_{shape}.json").write_text(json.dumps(log, indent=2))
    return log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(cfg_lib.ARCHS))
    ap.add_argument("--shape", required=True, choices=list(cfg_lib.SHAPES))
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    hillclimb(args.arch, args.shape, only=args.only)


if __name__ == "__main__":
    main()
