"""mamba2-2.7b's training step at the selection table's kernel plans
against the same step at the plans' own rules, in one process on one card
(the LM step whose SSD plans the committed entry at "mamba2 4096" sets).

    python3 tools/autotune_step.py

Each run is chip_smoke.py's ``lm`` (d) step of mamba2-2.7b at full width
(batch 1 x seq 4096, remat, f32, ``LM_PUBLISHED_STEPS`` steps through
``train()``, the last under torch.profiler): s a step, peak memory, the
losses and the port's kernels' device ms. "table" runs with the committed
tables (``artifacts/autotune_torch``) as the CUDA path reads them; "rules"
with every committed entry replaced in the process by an empty one, so
each plan is its rule's. The runs go rules, table, table, rules (a drift
of the card's clocks falls on both alike), and the last lines give each
side's step seconds (the steps after the first, which includes the
initialisation) and its kernels' device ms.
"""
from __future__ import annotations

import contextlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402

ARCH = "mamba2-2.7b"
ORDER = ("rules", "table", "table", "rules")


def _rules_only() -> None:
    """Every committed entry read as empty: each lookup a miss, each plan
    its rule's (in this process; the tables on disk unchanged)."""
    autotune.clear_cache()
    for op in autotune.OPS:
        path = autotune.table_dir() / f"{op}.json"
        entries = (json.loads(path.read_text())["entries"]
                   if path.exists() else {})
        for e in entries.values():
            autotune.record(op, e["shape"], e["dtype"], e["backend"], {},
                            1.0, 1.0, save=False)


class _Tee(io.StringIO):
    """Standard output kept as well as shown."""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        sys.__stdout__.flush()
        return super().write(text)


def main() -> int:
    chip_smoke.check(torch.cuda.is_available(), "needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, autotune.backend_id(), flush=True)
    ssd_kernel.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_configs.get_config(ARCH)
    steps = {"rules": [], "table": []}
    kernels = {"rules": {}, "table": {}}
    for side in ORDER:
        if side == "rules":
            _rules_only()
        else:
            autotune.clear_cache()
        out = _Tee()
        with contextlib.redirect_stdout(out):
            chip_smoke._lm_train(ARCH, chip_smoke._lm_names(cfg),
                                 chip_smoke.LM_PUBLISHED[ARCH], card,
                                 remat=True,
                                 steps=chip_smoke.LM_PUBLISHED_STEPS,
                                 label=f"step {side}")
        text = out.getvalue()
        # "s a step (the first with the init) [a, b, c]"
        found = re.search(r"s a step \(the first with the init\) \[([^]]*)\]",
                          text)
        steps[side] += [float(v) for v in found.group(1).split(",")[1:]]
        for name, ms in re.findall(r"profiled step: (.+?) x\d+ ([\d.]+) ms",
                                   text):
            kernels[side].setdefault(name, []).append(float(ms))
    autotune.clear_cache()
    for side in ("rules", "table"):
        whose = "the rules'" if side == "rules" else "the table's"
        print(f"{ARCH} at {whose} plans: s a step {steps[side]} (median "
              f"{statistics.median(steps[side]):.4f}); kernels' device ms "
              f"of the profiled steps {kernels[side]}; card {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
