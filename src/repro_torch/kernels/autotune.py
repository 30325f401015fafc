"""Kernel-selection tables over the CUDA kernels' launch plans (port of
``repro.kernels.autotune``).

In the reference, ``blocks_for`` is the single source of every Pallas op's
block shapes: an exact table match, else the op's heuristic. The port's
counterparts of those block choices are the free fields of its pure-Python
launch plans, which this module's tables set per (op, shape, dtype,
backend):

* ``fused_linear`` (shape ``(nb, m, k, n)``): the forward's and dx's split-K
  counts (``fwd_splits``, ``dx_splits``; :func:`.fused_linear.kernel._split`)
  and the CTA count of dw/db's Hopper form (``dw_ctas``). One entry routes
  the whole VJP, as one reference entry does.
* ``flash_attention`` (``(b, h, s, d)``): heads per block of the short and
  tensor-core short forms (``heads_per_block``), forward and backward alike;
  the tiled forms have no choice.
* ``ssd_scan`` (``(b, s, n, p, ds, chunk)``: the caller's chunk is an
  input, not a choice): the forward's ``inner`` chunk, ``heads`` per block,
  ``chunk_parallel`` form and tensor-core chunk-parallel form (``tc``), and
  the backward's tensor-core chunk-parallel form (``bwd_tc``) or heads per
  block (``bwd_heads``).

A plan's form stays what dtype and alignment dictate (the SSD's FMA and
tensor-core chunk-parallel forms are both free fields). An entry's fields
take effect only where the plan function's own checks admit them (shared
memory within the block's share, an inner chunk that divides the chunk,
heads that divide n, no more splits than ``depth // MIN_SPLIT_K``); a miss,
a corrupt table or an inadmissible entry gives the heuristic plan, which
launches the same CUDA kernel. So a stale entry can cost speed, never
correctness. :func:`validate_table` is strict and raises on either.

* **Persistent tables**: one JSON file per op under
  ``artifacts/autotune_torch/`` (:func:`table_dir`; tests monkeypatch it),
  keyed ``op|shape|dtype|backend``, the backend the card's compute
  capability and SM count (``cuda-sm90-132``: the plans size their grids by
  the SMs). Each entry carries its own shape, dtype and backend, so the key
  is re-derivable, the ``plan`` fields it sets, the winner's and the
  heuristic's times (``us``, ``baseline_us``) and the card they were
  measured on (``nvidia-smi`` name and power limit).
* **In-process LRU**: a lookup costs one dict hit per call. Only the CUDA
  path reads the tables (the wrappers' ``*_plan`` functions); CPU tensors
  take the plain versions and never look.
* **Sweeps** (:func:`sweep_fused_linear`, :func:`sweep_flash_attention`,
  :func:`sweep_ssd_scan`) run only when asked for (``tools/
  autotune_tables.py``): each times the admissible variants of the
  heuristic plan through the normal wrapper, captured in a CUDA graph and
  replayed between CUDA events, and records the winner. A lookup never
  sweeps.

    python -m repro_torch.kernels.autotune --check
"""
from __future__ import annotations

import collections
import functools
import json
import pathlib
import re
import types
from typing import Dict, List, Mapping, Optional, Sequence

TABLE_VERSION = 1

# op -> the plan fields an entry may set
OPS: Dict[str, tuple] = {
    "fused_linear": ("fwd_splits", "dx_splits", "dw_ctas"),
    "flash_attention": ("heads_per_block",),
    "ssd_scan": ("inner", "heads", "chunk_parallel", "tc", "bwd_heads",
                 "bwd_tc"),
}
# fields that are on/off; every other field is a positive count
_FLAGS = ("chunk_parallel", "tc", "bwd_tc")
# the length of each op's shape
_SHAPE_LEN = {"fused_linear": 4, "flash_attention": 4, "ssd_scan": 6}
# the operands' element size -> the key's dtype
DTYPES = {4: "float32", 2: "bfloat16"}
_BACKEND = re.compile(r"cuda-sm(\d+)-(\d+)")
_LRU_MAX = 1024
# a sweep keeps the heuristic's fields unless a variant is this much faster
MARGIN = 0.05
# a miss: no field set, the heuristic plan
_MISS: Mapping = types.MappingProxyType({})


def table_dir() -> pathlib.Path:
    """Directory holding the per-op selection tables (JSON)."""
    return (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
            / "autotune_torch")


@functools.lru_cache(maxsize=None)
def backend_id(index: int = 0) -> str:
    """The table's backend key of CUDA card ``index``: its compute
    capability and SM count, ``cuda-sm90-132`` for an H100 SXM."""
    import torch
    props = torch.cuda.get_device_properties(index)
    return (f"cuda-sm{props.major}{props.minor}-"
            f"{props.multi_processor_count}")


def backend_of(t) -> Optional[str]:
    """The backend key of tensor ``t``'s card, None for a CPU tensor (whose
    plans are the rules')."""
    return backend_id(t.device.index) if t.is_cuda else None


def backend_sms(backend: str) -> int:
    """The SM count a backend key names."""
    match = _BACKEND.fullmatch(backend)
    if match is None:
        raise ValueError(f"backend {backend!r}: expected cuda-sm<cc>-<sms>")
    return int(match.group(2))


def make_key(op: str, shape: Sequence[int], dtype: str, backend: str) -> str:
    """``op|shape|dtype|backend``: the deterministic table key."""
    return f"{op}|{'x'.join(str(int(s)) for s in shape)}|{dtype}|{backend}"


# ---------------------------------------------------------------------------
# table load / store
# ---------------------------------------------------------------------------

_TABLES: Dict[str, Dict[str, dict]] = {}          # op -> entries (in-process)
_LRU: "collections.OrderedDict[str, Mapping]" = collections.OrderedDict()


def _table_path(op: str, directory=None) -> pathlib.Path:
    return pathlib.Path(directory or table_dir()) / f"{op}.json"


def _entries(op: str) -> Dict[str, dict]:
    """Lazily loaded entries of ``op``; a missing or corrupt table is an
    empty one (the heuristic must never be blocked by disk state)."""
    if op not in _TABLES:
        try:
            entries = json.loads(_table_path(op).read_text())["entries"]
            if not isinstance(entries, dict):
                raise TypeError(entries)
        except (OSError, ValueError, KeyError, TypeError):
            entries = {}
        _TABLES[op] = entries
    return _TABLES[op]


def clear_cache() -> None:
    """Drop the in-process table and LRU caches (tests; new tables)."""
    _TABLES.clear()
    _LRU.clear()


def _valid_plan(op: str, plan) -> Optional[Mapping]:
    """``plan`` as a read-only mapping where its schema holds (fields of
    ``op``; flags bool, counts positive ints), else None."""
    if not isinstance(plan, dict) or not plan:
        return None
    for field, v in plan.items():
        if field not in OPS[op]:
            return None
        if field in _FLAGS:
            if not isinstance(v, bool):
                return None
        elif type(v) is not int or v <= 0:
            return None
    return types.MappingProxyType(dict(plan))


def blocks_for(op: str, shape: Sequence[int], dtype: str,
               backend: Optional[str]) -> Mapping:
    """The plan fields the table sets for one kernel call, read-only: an
    exact match's ``plan``, or an empty mapping (the heuristic) on a miss,
    a malformed entry or ``backend`` None. LRU first, then the table;
    never sweeps, never raises on a missing or corrupt table. The plan
    function still admits each field or keeps its own rule."""
    if backend is None:
        return _MISS
    key = make_key(op, shape, dtype, backend)
    hit = _LRU.get(key)
    if hit is not None:
        _LRU.move_to_end(key)
        return hit
    entry = _entries(op).get(key)
    plan = (_valid_plan(op, entry.get("plan")) if isinstance(entry, dict)
            else None) or _MISS
    _LRU[key] = plan
    if len(_LRU) > _LRU_MAX:
        _LRU.popitem(last=False)
    return plan


def record(op: str, shape: Sequence[int], dtype: str, backend: str,
           plan: Mapping, us: float, baseline_us: float, *,
           card: str = "", save: bool = True) -> dict:
    """Store an entry (a sweep's winner) in the table, and on disk when
    ``save``; the next lookup of its key sees it."""
    key = make_key(op, shape, dtype, backend)
    entry = {
        "shape": [int(s) for s in shape],
        "dtype": dtype,
        "backend": backend,
        "plan": dict(plan),
        "us": float(us),
        "baseline_us": float(baseline_us),
        "speedup_vs_default": float(baseline_us / us) if us > 0 else 1.0,
        "card": card,
    }
    _entries(op)[key] = entry
    _LRU.pop(key, None)
    if save:
        save_table(op)
    return entry


def save_table(op: str, directory=None) -> pathlib.Path:
    """Write ``op``'s entries to its JSON table in ``directory`` (default
    :func:`table_dir`; sorted keys: stable diffs)."""
    path = _table_path(op, directory)
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = _entries(op)
    payload = {"version": TABLE_VERSION, "op": op,
               "entries": {k: entries[k] for k in sorted(entries)}}
    path.write_text(json.dumps(payload, indent=2) + "\n")
    return path


def _kernel(op: str):
    """The kernel module whose plans ``op``'s table sets."""
    if op == "fused_linear":
        from repro_torch.kernels.fused_linear import kernel
    elif op == "flash_attention":
        from repro_torch.kernels.flash_attention import kernel
    else:
        from repro_torch.kernels.ssd_scan import kernel
    return kernel


def validate_table(op: str, directory=None) -> int:
    """Strict check of ``op``'s table on disk (in ``directory``, default
    :func:`table_dir`): the header, every key
    re-derived from its entry's own shape, dtype and backend, the plan's
    schema, every field admitted by the plan function at the entry's shape
    (contiguous, 16-byte aligned operands, the backend's SMs), positive
    times and the card recorded. Raises ValueError on the first failure;
    returns the entry count (a missing table has 0)."""
    path = _table_path(op, directory)
    if not path.exists():
        return 0
    payload = json.loads(path.read_text())
    if payload.get("version") != TABLE_VERSION or payload.get("op") != op:
        raise ValueError(f"{path}: bad version/op header: "
                         f"{payload.get('version')!r}/{payload.get('op')!r}")
    for key, e in payload["entries"].items():
        rekey = make_key(op, e["shape"], e["dtype"], e["backend"])
        if rekey != key:
            raise ValueError(f"{path}: key {key!r} does not round-trip "
                             f"(re-derived {rekey!r})")
        if (len(e["shape"]) != _SHAPE_LEN[op]
                or e["dtype"] not in DTYPES.values()):
            raise ValueError(f"{path}: entry {key!r} has a bad shape or "
                             "dtype")
        if _valid_plan(op, e["plan"]) is None:
            raise ValueError(f"{path}: entry {key!r} has a bad plan "
                             f"{e['plan']!r}")
        itemsize = {v: k for k, v in DTYPES.items()}[e["dtype"]]
        why = _kernel(op).entry_error(tuple(e["shape"]), itemsize,
                                      backend_sms(e["backend"]), e["plan"])
        if why is not None:
            raise ValueError(f"{path}: entry {key!r} is not admitted: {why}")
        if not (float(e["us"]) > 0 and float(e["baseline_us"]) > 0):
            raise ValueError(f"{path}: entry {key!r} has non-positive timing")
        if not (isinstance(e.get("card"), str) and e["card"]):
            raise ValueError(f"{path}: entry {key!r} names no card")
    return len(payload["entries"])


def candidates(op: str, shape: Sequence[int], dtype: str = "float32",
               sms: int = 132, **layout) -> Dict[str, List[dict]]:
    """The admissible plan variants at (op, shape, dtype) on a card of
    ``sms`` SMs, by the wrapper part that times them (fused linear: "fwd",
    "dx", "dw"; attention: "fwd+bwd"; SSD: "fwd", "bwd"), the heuristic's
    own fields first in each; only the parts that have a choice (none:
    an empty dict). ``layout``: what of the operands' layout the op's
    rules read (fused linear: ``shared``, one weight for every slot)."""
    if op not in OPS:
        raise KeyError(f"unknown op {op!r}; known: {sorted(OPS)}")
    itemsize = {v: k for k, v in DTYPES.items()}[dtype]
    return _kernel(op).table_choices(tuple(shape), itemsize, sms, **layout)


# ---------------------------------------------------------------------------
# sweeps (explicit only: the lookup path never calls these)
# ---------------------------------------------------------------------------


def capture(fn):
    """A CUDA graph of one call of ``fn`` (warmed up on a side stream, as
    capture needs): replaying it launches the call's kernels at the plans
    they had when captured, with no host work a launch, so events around
    replays time the card rather than the wrappers' Python."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_us(graph, iters: int) -> float:
    """µs a replay of ``graph`` over ``iters`` replays, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def _sweep(op: str, shape: tuple, dtype: str, backend: str, parts: dict,
           calls: dict, *, card: str, save: bool, iters: int,
           repeats: int, margin: float = MARGIN) -> Optional[dict]:
    """Time every part's variants through ``calls[part]`` (the normal
    wrapper, each variant planted in the table in turn) and record the
    winners' fields as one entry; None where no part has a choice. Each
    variant's call is captured in a CUDA graph (:func:`capture`), then
    timed over ``iters`` replays in each of ``repeats`` rounds that take
    the variants in turn (each round starting one later, so a drift of the
    card's clocks falls on all of them alike); a variant's time is its
    median. ``us`` and ``baseline_us`` sum the parts' best and heuristic
    times."""
    if not parts:
        return None
    key = make_key(op, shape, dtype, backend)
    before = _entries(op).get(key)
    plan, us, base = {}, 0.0, 0.0

    def plant(variant):
        record(op, shape, dtype, backend, {**plan, **variant}, 1.0, 1.0,
               save=False)
    try:
        for part, variants in parts.items():
            graphs = []
            for variant in variants:
                plant(variant)
                graphs.append(capture(calls[part]))
            runs = [[] for _ in variants]
            for r in range(repeats):
                for j in range(len(variants)):
                    i = (j + r) % len(variants)
                    runs[i].append(replay_us(graphs[i], iters))
            del graphs
            times = [sorted(t)[len(t) // 2] for t in runs]
            # the heuristic (first) stays unless a variant beats it by more
            # than ``margin``: a choice within the timing's noise moves
            # nothing
            best = min(range(len(times)), key=times.__getitem__)
            if times[best] > (1.0 - margin) * times[0]:
                best = 0
            plan.update(variants[best])
            us += times[best]
            base += times[0]
    except BaseException:
        # no planted variant outlives a failed sweep
        _entries(op).pop(key, None)
        if before is not None:
            _entries(op)[key] = before
        _LRU.pop(key, None)
        raise
    return record(op, shape, dtype, backend, plan, us, base, card=card,
                  save=save)


def sweep_fused_linear(nb: int, m: int, k: int, n: int,
                       dtype: str = "float32", *, shared: bool = False,
                       activation: str = "relu", card: str = "",
                       save: bool = True, seed: int = 0, iters: int = 20,
                       repeats: int = 7) -> Optional[dict]:
    """Sweep the forward's and dx's split counts and dw/db's CTA count at
    one (nb, m, k, n) (``shared``: one weight for every slot, a stride-0
    view, as the statistics pass has it), each through its wrapper, and
    record the winners as one entry."""
    import torch
    from repro_torch.kernels.fused_linear import kernel
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*s, scale=1.0):
        return (torch.randn(*s, device="cuda", generator=g) * scale).to(tdt)
    x = draw(nb, m, k)
    w = draw(1 if shared else nb, k, n, scale=(2.0 / k) ** 0.5)
    b = draw(1 if shared else nb, n)
    if shared:
        w, b = w.expand(nb, k, n), b.expand(nb, n)
    dy = draw(nb, m, n)
    y = kernel.fused_linear(x, w, b, activation)
    mask = "relu" if activation == "relu" else "none"
    ys = y if mask == "relu" else None
    backend = backend_id(x.device.index)
    calls = {"fwd": lambda: kernel.fused_linear(x, w, b, activation),
             "dx": lambda: kernel.fused_linear_bwd_dx(dy, w, ys, mask),
             "dw": lambda: kernel.fused_linear_bwd_dw_db(x, dy, ys, mask)}
    parts = candidates("fused_linear", (nb, m, k, n), dtype,
                       backend_sms(backend), shared=shared)
    return _sweep("fused_linear", (nb, m, k, n), dtype, backend, parts,
                  calls, card=card, save=save, iters=iters, repeats=repeats)


def sweep_flash_attention(b: int, h: int, s: int, d: int,
                          dtype: str = "float32", *, causal: bool = True,
                          card: str = "", save: bool = True, seed: int = 0,
                          iters: int = 20, repeats: int = 7) -> Optional[dict]:
    """Sweep heads per block at one (B, H, S, D) attention shape, the
    forward and the backward together (one field sets both); None where
    the plan is tiled (no choice)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k_, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g)
                    .to(tdt).transpose(1, 2) for _ in range(4))
    o, lse = kernel.flash_attention(q, k_, v, causal)
    delta = (do.float() * o.float()).sum(-1)

    def step():
        kernel.flash_attention(q, k_, v, causal)
        kernel.flash_attention_bwd(q, k_, v, do, lse, delta, causal)
    backend = backend_id(q.device.index)
    parts = candidates("flash_attention", (b, h, s, d), dtype,
                       backend_sms(backend))
    return _sweep("flash_attention", (b, h, s, d), dtype, backend, parts,
                  {"fwd+bwd": step}, card=card, save=save, iters=iters,
                  repeats=repeats)


def sweep_ssd_scan(b: int, s: int, n: int, p: int, ds: int, chunk: int,
                   dtype: str = "float32", *, card: str = "",
                   save: bool = True, seed: int = 0, iters: int = 10,
                   repeats: int = 7) -> Optional[dict]:
    """Sweep the SSD forward's inner chunk, heads per block and forms, and
    the backward's form and heads per block, at one (B, S, n, p, ds,
    chunk)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    conv = torch.randn(b, s, n * p + 2 * ds, device="cuda",
                       generator=g).to(tdt)
    x = conv[..., :n * p].reshape(b, s, n, p)
    bm, cm = conv[..., n * p:n * p + ds], conv[..., n * p + ds:]
    dt = F.softplus(torch.randn(b, s, n, device="cuda", generator=g))
    a_log = (0.5 * torch.randn(n, device="cuda", generator=g)).to(tdt)
    dy = torch.randn(b, s, n, p, device="cuda", generator=g).to(tdt)
    chunk = min(chunk, s)
    calls = {"fwd": lambda: kernel.ssd_scan(x, dt, a_log, bm, cm,
                                            chunk=chunk),
             "bwd": lambda: kernel.ssd_scan_bwd(x, dt, a_log, bm, cm, dy,
                                                chunk=chunk)}
    backend = backend_id(x.device.index)
    shape = (b, s, n, p, ds, chunk)
    parts = candidates("ssd_scan", shape, dtype, backend_sms(backend))
    return _sweep("ssd_scan", shape, dtype, backend, parts, calls,
                  card=card, save=save, iters=iters, repeats=repeats)


def _main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate the committed kernel-selection tables "
                    "(load -> schema -> re-key -> admission).")
    ap.add_argument("--check", action="store_true",
                    help="strict validation of every op table")
    args = ap.parse_args()
    if args.check:
        for op in OPS:
            n = validate_table(op)
            print(f"{op}: {n} entries OK ({_table_path(op)})")


if __name__ == "__main__":
    _main()
