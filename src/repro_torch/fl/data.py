"""Synthetic SVHN/CIFAR-like non-IID data pipeline.

Container is offline, so we synthesize a 10-class 32x32x3 task whose class
structure is learnable by VGG/MLP: each class has a smooth random template;
samples are template + noise + random brightness. Non-IID partitioning
follows the paper/[50]: device n holds data points from ``q`` classes only
("q_m-class non-IID"), with non-IID degree ``chi`` (proportion of q-class
points; the rest is IID spillover).

The port's copy of ``repro.fl.data``'s host data plane: every draw comes from
the same numpy ``Generator`` in the same order, so datasets and packed
cohort batches are byte-identical to the reference's for a seed. Arrays stay
numpy here; the cohort engine moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FLDataset:
    """Synthetic non-IID FL dataset: one private shard per device plus a
    shared IID test set (see the module docstring for how it is generated)."""
    x_dev: List[np.ndarray]     # per-device images (D_n, 32, 32, 3) or
    #                             tokens (D_n, seq_len)
    y_dev: List[np.ndarray]
    x_test: np.ndarray
    y_test: np.ndarray
    classes_of: List[np.ndarray]


def _class_templates(rng: np.random.Generator, classes: int, size: int = 32):
    """Smooth random template per class (low-freq Fourier pattern)."""
    t = []
    coords = np.linspace(0, 2 * np.pi, size)
    xx, yy = np.meshgrid(coords, coords)
    for _ in range(classes):
        img = np.zeros((size, size, 3))
        for c in range(3):
            for _ in range(4):
                fx, fy = rng.integers(1, 4, 2)
                ph = rng.uniform(0, 2 * np.pi, 2)
                img[:, :, c] += rng.normal() * np.sin(fx * xx + ph[0]) * np.cos(fy * yy + ph[1])
        t.append(img / np.abs(img).max())
    return np.stack(t)


def _sample(rng, templates, cls: np.ndarray, noise: float = 0.35):
    base = templates[cls]
    jitter = rng.normal(0, noise, base.shape)
    bright = rng.uniform(0.7, 1.3, (len(cls), 1, 1, 1))
    return (base * bright + jitter).astype(np.float32)


def make_fl_dataset(n_devices: int, sizes: np.ndarray, q_classes: np.ndarray,
                    chi: float = 1.0, classes: int = 10, test_size: int = 1000,
                    seed: int = 0) -> FLDataset:
    """sizes: (N,) local dataset sizes D_n; q_classes: (N,) classes per device."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, classes)
    x_dev, y_dev, cls_of = [], [], []
    for n in range(n_devices):
        own = rng.choice(classes, size=min(int(q_classes[n]), classes), replace=False)
        cls_of.append(own)
        d = int(sizes[n])
        n_noniid = int(round(chi * d))
        y = np.concatenate([
            rng.choice(own, size=n_noniid),
            rng.integers(0, classes, size=d - n_noniid),
        ]).astype(np.int32)
        rng.shuffle(y)
        x_dev.append(_sample(rng, templates, y))
        y_dev.append(y)
    y_test = np.tile(np.arange(classes), test_size // classes).astype(np.int32)
    x_test = _sample(rng, templates, y_test)
    return FLDataset(x_dev, y_dev, x_test, y_test, cls_of)


# ---------------------------------------------------------------------------
# Token corpora for the sequence models (next-token prediction)
# ---------------------------------------------------------------------------


def _markov_steps(rng: np.random.Generator, succ_dev: np.ndarray,
                  succ_glob: np.ndarray, chi: float, vocab: int,
                  n_seq: int, length: int) -> np.ndarray:
    """Walk ``n_seq`` Markov chains of ``length`` tokens at once.

    Each token's successors are one of ``branching`` table entries; every
    step mixes the device's private table with the shared global one by
    ``chi`` (the token twin of the q-class non-IID mixing).
    """
    seq = np.empty((n_seq, length), np.int32)
    tok = rng.integers(0, vocab, size=n_seq).astype(np.int32)
    seq[:, 0] = tok
    branching = succ_glob.shape[1]
    for t in range(1, length):
        branch = rng.integers(0, branching, size=n_seq)
        use_dev = rng.random(n_seq) < chi
        tok = np.where(use_dev, succ_dev[tok, branch],
                       succ_glob[tok, branch]).astype(np.int32)
        seq[:, t] = tok
    return seq


def make_token_fl_dataset(n_devices: int, sizes: np.ndarray, vocab: int = 128,
                          seq_len: int = 32, chi: float = 1.0,
                          branching: int = 4, test_size: int = 256,
                          seed: int = 0) -> FLDataset:
    """Synthetic non-IID token corpora for next-token prediction.

    Device ``n`` holds ``sizes[n]`` sequences of ``seq_len`` tokens drawn
    from a Markov chain: a *shared* global successor table chi-mixed with a
    *private* per-device table (each device speaks its own dialect).
    ``x_dev[n]`` is ``(D_n, seq_len)`` int32 tokens, ``y_dev[n]`` the
    shifted next-token labels; the shared test set is drawn from the global
    table alone. Byte-identical to the reference's for a seed.
    """
    rng = np.random.default_rng(seed)
    succ_glob = rng.integers(0, vocab, size=(vocab, branching))
    x_dev, y_dev, cls_of = [], [], []
    for n in range(n_devices):
        succ_dev = rng.integers(0, vocab, size=(vocab, branching))
        cls_of.append(np.unique(succ_dev))
        seq = _markov_steps(rng, succ_dev, succ_glob, chi, vocab,
                            int(sizes[n]), seq_len + 1)
        x_dev.append(seq[:, :-1].copy())
        y_dev.append(seq[:, 1:].copy())
    seq = _markov_steps(rng, succ_glob, succ_glob, 0.0, vocab,
                        test_size, seq_len + 1)
    return FLDataset(x_dev, y_dev, seq[:, :-1].copy(), seq[:, 1:].copy(),
                     cls_of)


def sample_batch(rng: np.random.Generator, ds: FLDataset, n: int,
                 batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one training batch (without replacement) from device ``n``'s
    private shard; the batch shrinks to the shard size when it is smaller."""
    idx = rng.choice(len(ds.y_dev[n]), size=min(batch, len(ds.y_dev[n])),
                     replace=False)
    return ds.x_dev[n][idx], ds.y_dev[n][idx]


@dataclasses.dataclass
class CohortBatch:
    """Fixed-shape padded per-device batches for the cohort engine.

    Every round produces the SAME array shapes regardless of which devices
    participate — (N, B_pad, ...) with a validity mask. Non-participating
    devices keep all-zero rows and an all-zero mask.
    """
    x: np.ndarray        # (N, B_pad, ...) float32
    y: np.ndarray        # (N, B_pad) int32
    mask: np.ndarray     # (N, B_pad) float32, 1.0 on valid rows


@dataclasses.dataclass(frozen=True)
class CohortLayout:
    """Tiered slot layout for the cohort engines (fixed across all rounds).

    The single-width contract pads every slot to the *global* maximum
    training batch ``max(d_tilde)``, wasting up to ~2x the samples actually
    trained on. A tiered layout instead pads slot *i* to (roughly) the i-th
    largest global ``d_tilde``: the slots are split into ``len(tier_widths)``
    contiguous tiers, every slot in tier *k* is ``tier_widths[k]`` samples
    wide, and the cohort round runs one slot-batched segment per tier. Widths are derived from the global (all-device)
    ``d_tilde`` vector, so the layout — and therefore every array shape —
    never changes across rounds, device subsets or partition decisions.

    **Fit guarantee.** Widths descend tier over tier and devices are packed
    into slots in decreasing batch-size order, so the k-th largest
    participating batch always lands in a slot at least as wide as the k-th
    largest global ``d_tilde`` — every participant fits, for every subset of
    at most ``capacity`` devices.

    ``shard_count`` rounds each tier's slot count up to a multiple of the
    cohort-mesh size so a sharded engine can split every tier evenly across
    devices; the extra slots stay permanently empty (zero mask/weight).
    """
    tier_widths: Tuple[int, ...]    # padded batch width per tier (descending)
    tier_slots: Tuple[int, ...]     # number of slots per tier

    #: candidate tier counts scanned by ``tiers="auto"`` (bounds the number
    #: of per-tier segments the cohort round runs)
    AUTO_MAX_TIERS = 8

    @classmethod
    def build(cls, d_tilde: np.ndarray, capacity: Optional[int] = None,
              tiers=1, shard_count: int = 1) -> "CohortLayout":
        """Derive a layout from the global per-device batch sizes.

        ``capacity``: number of (pre-padding) slots — the most devices a
        round can schedule (defaults to all devices). ``tiers``: how many
        distinct widths to use (1 reproduces the single-width contract), or
        ``"auto"`` to pick the count from the d_tilde histogram (see
        :meth:`auto_tiers`). ``shard_count``: round every tier's slot count
        up to this multiple.
        """
        widths = np.sort(np.asarray(d_tilde, dtype=int))[::-1]
        capacity = len(widths) if capacity is None else int(capacity)
        assert 1 <= capacity <= len(widths), (capacity, len(widths))
        if tiers == "auto":
            tiers = cls.auto_tiers(d_tilde, capacity, shard_count)
        tiers = max(1, min(int(tiers), capacity))
        groups = np.array_split(np.arange(capacity), tiers)
        tier_widths, tier_slots = [], []
        for g in groups:
            tier_widths.append(int(widths[g[0]]))     # widest in the group
            n_slots = -(-len(g) // shard_count) * shard_count
            tier_slots.append(int(n_slots))
        return cls(tuple(tier_widths), tuple(tier_slots))

    @classmethod
    def auto_tiers(cls, d_tilde: np.ndarray, capacity: Optional[int] = None,
                   shard_count: int = 1) -> int:
        """Pick a tier count from the padded-samples curve.

        Evaluates ``padded_samples`` for every candidate tier count
        ``1..min(capacity, AUTO_MAX_TIERS)`` and returns the smallest count
        reaching the curve's floor — the elbow where extra tiers stop
        paying for their extra segments. ``array_split`` groupings are
        not nested, so the curve is *not* monotone (and ``shard_count``
        rounding can make more tiers strictly worse); taking the argmin of
        the realized curve (ties -> fewest tiers) both rides the elbow and
        guarantees auto never pads more than any manual choice among the
        candidates — in particular the {1, 4}-tier baselines.
        """
        widths = np.asarray(d_tilde, dtype=int)
        capacity = len(widths) if capacity is None else int(capacity)
        candidates = range(1, min(capacity, cls.AUTO_MAX_TIERS) + 1)
        padded = [cls.build(widths, capacity, t, shard_count).padded_samples
                  for t in candidates]
        return 1 + int(np.argmin(padded))

    @property
    def n_slots(self) -> int:
        """Total slot count (after any shard_count rounding)."""
        return sum(self.tier_slots)

    @property
    def slot_widths(self) -> np.ndarray:
        """(n_slots,) padded width of every slot, in tier-major order."""
        return np.repeat(self.tier_widths, self.tier_slots)

    @property
    def padded_samples(self) -> int:
        """Samples the fused round computes on per epoch (the whole padded
        slot area — empty and partially-filled slots included)."""
        return int(np.dot(self.tier_widths, self.tier_slots))

    def locate(self, slot: int) -> Tuple[int, int]:
        """Map a tier-major global slot index to its (tier, row) pair."""
        for k, s in enumerate(self.tier_slots):
            if slot < s:
                return k, slot
            slot -= s
        raise IndexError(slot)


@dataclasses.dataclass
class TieredCohortBatch:
    """Per-tier padded batches + the device->slot assignment of one round.

    ``tiers[k]`` holds tier *k*'s arrays with shape
    ``(layout.tier_slots[k], layout.tier_widths[k], ...)``; ``slot_of[i]``
    is the tier-major global slot that ``device_ids[i]``'s samples landed
    in. Per-slot engine outputs (losses, boundary RMS) use the same
    tier-major indexing, so ``out[slot_of]`` scatters them back to devices.
    """
    tiers: Tuple[CohortBatch, ...]
    slot_of: np.ndarray              # (len(device_ids),) int
    layout: CohortLayout


def zero_slot_rows(batch: "TieredCohortBatch", slots) -> "TieredCohortBatch":
    """Return a copy of ``batch`` with the given tier-major slots zeroed.

    The per-row validity mask doubles as a **completion mask**: a slot whose
    mask is all-zero contributes an exact-zero loss and exact-zero gradients
    to the fused round (``masked_xent_loss`` sums over valid rows only), so
    zeroing a slot models a device that never executed its dispatch — e.g.
    one that churned offline — without changing any array shape. The fused
    round still runs the slot (shapes stay fixed), but its
    parameters stay at the broadcast global model and its zero FedAvg weight
    keeps it out of every aggregate. ``batch`` is not mutated; with no
    ``slots`` it is returned as-is.
    """
    slots = list(slots)
    if not slots:
        return batch
    tiers = [CohortBatch(t.x.copy(), t.y.copy(), t.mask.copy())
             for t in batch.tiers]
    for s in slots:
        k, row = batch.layout.locate(int(s))
        tiers[k].x[row] = 0.0
        tiers[k].y[row] = 0
        tiers[k].mask[row] = 0.0
    return TieredCohortBatch(tuple(tiers), batch.slot_of, batch.layout)


def sample_cohort_batch(rng: np.random.Generator, ds: FLDataset,
                        device_ids, batch_sizes: np.ndarray,
                        pad_to: Optional[int] = None,
                        capacity: Optional[int] = None,
                        layout: Optional[CohortLayout] = None,
                        ):
    """Sample one padded batch per device in ``device_ids``.

    This function owns the cohort packing contract. Draws always come from
    ``rng`` in the order given by ``device_ids`` with exactly the same calls
    as the sequential ``sample_batch`` loop, so every engine (sequential,
    cohort, sharded) sees identical data for identical rng states.

    Three layouts, one sampling order:

    * default — the leading axis indexes *all* devices (row n = device n),
      every row padded to ``pad_to``; returns a :class:`CohortBatch`.
    * ``capacity`` — participants are packed into ``capacity``
      ``pad_to``-wide slots in ``device_ids`` order — the scheduler can
      select at most (channels x shop-floor size) devices per round, so a
      fixed slot count keeps shapes static while skipping compute for
      absent devices; returns a :class:`CohortBatch`.
    * ``layout`` — tiered slot widths (:class:`CohortLayout`): after
      sampling, devices are assigned to slots in decreasing batch-size
      order (tier-major), which the layout's fit guarantee makes always
      succeed; returns a :class:`TieredCohortBatch` carrying the
      device->slot assignment.
    """
    device_ids = [int(n) for n in device_ids]
    if layout is not None:
        assert len(device_ids) <= layout.n_slots, \
            "more participants than cohort slots"
        draws = [sample_batch(rng, ds, n, int(batch_sizes[n]))
                 for n in device_ids]                  # rng order preserved
        lens = np.array([len(yb) for _, yb in draws], dtype=int)
        sample_shape = ds.x_dev[0].shape[1:]
        label_shape = ds.y_dev[0].shape[1:]
        tiers = [CohortBatch(
            np.zeros((s, w) + sample_shape, ds.x_dev[0].dtype),
            np.zeros((s, w) + label_shape, ds.y_dev[0].dtype),
            np.zeros((s, w), np.float32))
            for s, w in zip(layout.tier_slots, layout.tier_widths)]
        slot_of = np.empty(len(device_ids), dtype=int)
        # largest batches first: rank r goes to global slot r, whose width
        # is >= the r-th largest global d_tilde >= this batch (fit guarantee)
        for rank, di in enumerate(np.argsort(-lens, kind="stable")):
            k, row = layout.locate(rank)
            xb, yb = draws[di]
            b = len(yb)
            assert b <= layout.tier_widths[k], (b, layout.tier_widths[k])
            tiers[k].x[row, :b] = xb
            tiers[k].y[row, :b] = yb
            tiers[k].mask[row, :b] = 1.0
            slot_of[di] = rank
        return TieredCohortBatch(tuple(tiers), slot_of, layout)

    assert pad_to is not None, "pad_to is required without a layout"
    packed = capacity is not None
    rows = capacity if packed else len(ds.y_dev)
    assert len(device_ids) <= rows, "more participants than cohort slots"
    sample_shape = ds.x_dev[0].shape[1:]
    label_shape = ds.y_dev[0].shape[1:]
    x = np.zeros((rows, pad_to) + sample_shape, ds.x_dev[0].dtype)
    y = np.zeros((rows, pad_to) + label_shape, ds.y_dev[0].dtype)
    mask = np.zeros((rows, pad_to), np.float32)
    for slot, n in enumerate(device_ids):
        xb, yb = sample_batch(rng, ds, n, int(batch_sizes[n]))
        b = len(yb)
        row = slot if packed else n
        x[row, :b] = xb
        y[row, :b] = yb
        mask[row, :b] = 1.0
    return CohortBatch(x, y, mask)
