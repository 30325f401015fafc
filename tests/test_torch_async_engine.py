"""The port's buffered async engine and fault injection
(``repro_torch.fl.async_engine``, ``repro_torch.fl.faults``) against
``repro``'s, on ``tests/test_async_engine.py``'s small MLP network (4
gateways, 8 devices, 2 channels).

The control side is numpy in both packages, drawn from the same streams
in the same order, so fault draws, the heap's pop order, staleness,
realized participation, queues and delays must be identical; the data
plane (losses, params) agrees at the reference's 1e-5 contract. Against
the reference the port starts from the reference's statistics, weights
and batch stream. Also F10: ``Simulation.__init__`` validates the fault
axes and ``buffer_k`` case for case as the reference does.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.network import NetworkConfig as RefNetworkConfig  # noqa
from repro.fl import faults as ref_faults  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.core.lyapunov import update_queues  # noqa: E402
from repro_torch.core.network import NetworkConfig  # noqa: E402
from repro_torch.fl import faults, sim  # noqa: E402
from repro_torch.fl.async_engine import (AsyncCohortEngine,  # noqa: E402
                                         BufferedUpdate)
from repro_torch.models.convert import params_to_numpy  # noqa: E402

BASE = dict(model="mlp", rounds=8, eval_every=10, seed=3, max_dataset=120,
            engine="async")
FAULTED = dict(churn=0.3, dropout=0.1, straggler_frac=0.5,
               straggler_scale=3.0)
# faulted runs: buffer_k=2 with max_staleness=1 (an update parked in an
# under-full buffer), buffer_k=1 (staleness accrues, updates stay in
# flight) and the same with max_staleness=0 (stale updates discarded)
RUNS = {"faulted": dict(FAULTED, buffer_k=2, max_staleness=1),
        "stale": dict(FAULTED, buffer_k=1),
        "capped": dict(FAULTED, buffer_k=1, max_staleness=0),
        "degenerate": {}}
TOL = dict(atol=1e-5, rtol=1e-5)
# the record fields the control side decides, compared exactly
EXACT = ("t", "selected", "trained", "l_n", "delay", "cum_delay", "queues",
         "failures", "aggregations", "staleness_mean", "staleness_max",
         "stale_discarded", "dropped_devices", "lost_devices",
         "straggler_devices", "buffer_fill", "inflight")


def _scenario(**kw):
    return sim.Scenario(**{**BASE, "net": NetworkConfig(4, 8, 2), **kw})


def _ref_scenario(**kw):
    return ref_sim.Scenario(**{**BASE, "net": RefNetworkConfig(4, 8, 2),
                               **kw})


_REF = {}


def _reference(name, policy="ddsra"):
    """The reference's run of ``RUNS[name]``, with its starting point."""
    if (name, policy) not in _REF:
        r = ref_sim.Simulation(_ref_scenario(**RUNS[name]))
        out = dict(sim=r, rng0=r.rng.bit_generator.state, stats=r.stats,
                   params0=[jax.tree.map(np.asarray, p) for p in r.params])
        out["records"] = list(r.rounds(policy))
        out["final"] = [jax.tree.map(np.asarray, p) for p in r.params]
        _REF[(name, policy)] = out
    return _REF[(name, policy)]


def _port_from(ref, **kw):
    """A port simulation at the reference's starting point."""
    s = sim.Simulation(_scenario(**kw), ref["stats"], device="cpu",
                       init_params=ref["params0"])
    s.rng.bit_generator.state = ref["rng0"]
    return s


def _assert_records(got, want, exact=EXACT):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in exact:
            a, b = getattr(g, name), getattr(w, name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, (g.t, name, a, b)
        np.testing.assert_allclose(g.losses, w.losses, **TOL)
        assert (g.accuracy is None) == (w.accuracy is None)


def _assert_params(got, want, **tol):
    for g, w in zip(got, want):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _np_params(s):
    return params_to_numpy(s.plan, s.params)


# ---------------------------------------------------------------------------
# the fault model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_draw_round_faults_matches_reference(seed):
    """The same four draws from the same stream, in the same order, over a
    grid of rates; an inactive model draws nothing."""
    rates = [(0.0, 0.0, 0.0, 0.0), (0.3, 0.1, 0.5, 3.0), (0.0, 0.2, 0.0, 0.0),
             (0.9, 0.0, 0.0, 0.0), (0.0, 0.0, 0.5, 0.0), (0.0, 0.0, 0.99, 1.0),
             (0.5, 0.5, 0.5, 0.5)]
    for n in (1, 8, 33):
        rng, ref_rng = (np.random.default_rng(seed) for _ in range(2))
        for rate in rates:
            m = faults.FaultModel(*rate)
            rm = ref_faults.FaultModel(*rate)
            assert m.active == rm.active
            for _ in range(3):
                got = faults.draw_round_faults(rng, m, n)
                want = ref_faults.draw_round_faults(ref_rng, rm, n)
                for f in ("dropped", "lost", "straggle"):
                    a, b = getattr(got, f), getattr(want, f)
                    assert a.dtype == b.dtype and np.array_equal(a, b), f
                assert rng.bit_generator.state == \
                    ref_rng.bit_generator.state
    # inactive (straggle without a scale included): zero draws
    rng = np.random.default_rng(seed)
    before = rng.bit_generator.state
    for rate in ((0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.7, 0.0)):
        clear = faults.draw_round_faults(rng, faults.FaultModel(*rate), 5)
        assert not (clear.dropped.any() or clear.lost.any()
                    or clear.straggle.any())
    assert rng.bit_generator.state == before


# ---------------------------------------------------------------------------
# F10: the fault-axis and buffer_k validation, case for case
# ---------------------------------------------------------------------------


F10_CASES = {
    "inactive-straggle": dict(straggler_frac=0.5, straggler_scale=0.0),
    "churn-1.5": dict(churn=1.5),
    "dropout-negative": dict(dropout=-0.1),
    "straggle-1.0": dict(straggler_frac=1.0),
    "scale-negative": dict(straggler_scale=-1.0),
    "buffer_k-0": dict(buffer_k=0),
    "buffer_k-0-and-churn-2": dict(buffer_k=0, churn=2.0),
    "churn-on-cohort": dict(churn=0.1),
    "buffer_k-on-cohort": dict(buffer_k=2),
    "dropout-on-sequential": dict(dropout=0.2, engine="sequential"),
    "straggle-on-sequential": dict(straggler_frac=0.1, straggler_scale=1.0,
                                   engine="sequential"),
    "faults-on-async": dict(churn=0.1, buffer_k=2, engine="async"),
}


def _outcome(fn):
    """("ok", None) if ``fn()`` returns, else (type name, message)."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return "ok", None


@pytest.mark.parametrize("case", sorted(F10_CASES))
def test_fault_validation_matches_reference(case):
    """F10: the port validated the fault axes its own way (any nonzero
    rate or any ``buffer_k`` refused); now ``Simulation.__init__`` raises
    what the reference raises, in its order and with its message, and runs
    what it runs (an inactive straggle, faults on the async engine)."""
    kw = {"engine": "cohort", "rounds": 1, **F10_CASES[case]}
    want = _outcome(lambda: ref_sim.Simulation(_ref_scenario(**kw)))
    got = _outcome(lambda: sim.Simulation(_scenario(**kw), device="cpu"))
    assert got == want
    if case in ("inactive-straggle", "faults-on-async"):
        assert got == ("ok", None)
    else:
        assert got[0] == "ValueError"


# ---------------------------------------------------------------------------
# against the reference's async engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["ddsra", "round_robin"])
def test_degenerate_async_matches_cohort_and_reference(policy):
    """No faults and ``buffer_k=None``: the async engine replays the port's
    cohort engine (records identical, delays at rtol 1e-9, params at
    1e-5) and the reference's async engine record for record."""
    ref = _reference("degenerate", policy)
    s = _port_from(ref)
    recs = list(s.rounds(policy))
    _assert_records(recs, ref["records"])
    _assert_params(_np_params(s), ref["final"], **TOL)
    assert s.net.rng.bit_generator.state == \
        ref["sim"].net.rng.bit_generator.state

    c = _port_from(ref, engine="cohort")
    sync = list(c.rounds(policy))
    assert any(r.trained for r in sync)
    for a, b in zip(sync, recs):
        for name in ("selected", "trained", "l_n", "queues", "failures",
                     "aggregations"):
            va, vb = getattr(a, name), getattr(b, name)
            assert np.array_equal(va, vb), (a.t, name)
        np.testing.assert_allclose(b.delay, a.delay, rtol=1e-9)
        np.testing.assert_allclose(b.losses, a.losses, **TOL)
        assert (b.staleness_max, b.stale_discarded, b.buffer_fill,
                b.inflight) == (0, 0, 0, 0)
    _assert_params(_np_params(s), _np_params(c), **TOL)
    assert c.rng.bit_generator.state == s.rng.bit_generator.state
    assert c.net.rng.bit_generator.state == s.net.rng.bit_generator.state


@pytest.mark.parametrize("name", ["faulted", "stale", "capped"])
def test_faulted_run_matches_reference(name):
    """The faulted runs record for record: fault counts, staleness,
    discards, buffer fill and in-flight counts, the realized queues and
    delays identical; losses and params at 1e-5."""
    ref = _reference(name)
    s = _port_from(ref, **RUNS[name])
    recs = list(s.rounds("ddsra"))
    _assert_records(recs, ref["records"])
    _assert_params(_np_params(s), ref["final"], **TOL)
    assert sum(r.dropped_devices for r in recs) > 0
    assert sum(r.straggler_devices for r in recs) > 0
    # each run exercises what it is for
    assert {"faulted": any(r.buffer_fill for r in recs),
            "stale": max(r.staleness_max for r in recs) >= 1
            and any(r.inflight for r in recs),
            "capped": sum(r.stale_discarded for r in recs) > 0}[name]
    assert s.net.rng.bit_generator.state == \
        ref["sim"].net.rng.bit_generator.state
    np.testing.assert_array_equal(s.engine.inflight_counts(s),
                                  ref["sim"].engine.inflight_counts(
                                      ref["sim"]))
    assert s.engine.inflight_counts(s).sum() == recs[-1].inflight


def test_boundary_telemetry_on_the_async_engine():
    """``rounds(boundary=True)`` reports each trained device's boundary
    RMS (zero elsewhere), as the reference's async engine does."""
    ref = _reference("faulted")
    s = _port_from(ref, **RUNS["faulted"])
    r = ref_sim.Simulation(_ref_scenario(**RUNS["faulted"]), ref["stats"])
    r.params = [jax.tree.map(jax.numpy.asarray, p) for p in ref["params0"]]
    r.rng.bit_generator.state = ref["rng0"]
    for got, want in zip(s.rounds("ddsra", boundary=True),
                         r.rounds("ddsra", boundary=True)):
        assert got.trained == want.trained
        if want.boundary_rms is None:
            assert got.boundary_rms is None
        else:
            np.testing.assert_allclose(got.boundary_rms, want.boundary_rms,
                                       **TOL)
        if got.t == 2:
            break


def test_realized_queues_diverge_from_schedule_under_churn():
    """With heavy churn some selected gateway's update never lands, so the
    recorded queues diverge from the scheduled Eq. (14) update: the
    realized-participation feedback fired."""
    s = sim.Simulation(_scenario(churn=0.5, rounds=10), device="cpu")
    prev = np.zeros(s.net.cfg.n_gateways)
    diverged = False
    for rec in s.rounds("ddsra"):
        if not np.array_equal(update_queues(prev, rec.selected, s.gamma),
                              rec.queues):
            diverged = True
        prev = rec.queues
    assert diverged


def _model(value):
    return [{"w": torch.full((2,), float(value))}]


def _engine_only_sim(max_staleness=None, staleness_alpha=0.5):
    """The minimal stand-in ``_land_and_aggregate`` needs: scenario knobs
    plus a writable ``params`` slot."""
    return types.SimpleNamespace(
        scenario=types.SimpleNamespace(max_staleness=max_staleness,
                                       staleness_alpha=staleness_alpha),
        params=None)


def test_parked_straggler_charges_its_arrival_at_aggregation():
    """An update landing into an under-full buffer is parked, not paid
    for; when a later round's aggregation consumes it, the charged delay
    covers its arrival. The aggregate is the staleness-weighted FedAvg."""
    eng = AsyncCohortEngine()
    for arrival in (5.0, 100.0):        # 100.0: the heavy straggler
        eng._pending_push(BufferedUpdate(gateway=0, version=0,
                                         arrival=arrival, seq=eng._seq,
                                         weight=1.0, model=_model(1.0)))
    s = _engine_only_sim()
    delay, agg, _, _ = eng._land_and_aggregate(s, barrier=False,
                                               buffer_k=3, now=0.0)
    assert delay == 0.0 and not agg and len(eng._buffer) == 2

    eng._pending_push(BufferedUpdate(gateway=1, version=0, arrival=3.0,
                                     seq=eng._seq, weight=2.0,
                                     model=_model(4.0)))
    delay, agg, staleness, _ = eng._land_and_aggregate(
        s, barrier=False, buffer_k=3, now=0.0)
    assert len(agg) == 3 and staleness == [0, 0, 0]
    assert delay == 100.0               # not 3.0 (this round's only pop)
    assert torch.allclose(s.params[0]["w"], torch.full((2,), 2.5))
    assert eng._version == 1

    # arrivals earlier than now land free of charge
    eng._pending_push(BufferedUpdate(gateway=0, version=0, arrival=2.0,
                                     seq=eng._seq, weight=1.0,
                                     model=_model(1.0)))
    delay, agg, staleness, _ = eng._land_and_aggregate(
        s, barrier=False, buffer_k=1, now=50.0)
    assert len(agg) == 1 and delay == 0.0 and staleness == [1]


def test_reset_and_restart_clear_the_engine():
    """``reset()`` and ``restart()`` drop in-flight and parked updates and
    rewind the counters; a replay after ``reset()`` matches a fresh
    simulation record for record."""
    sc = _scenario(**RUNS["faulted"], rounds=6)
    s = sim.Simulation(sc, device="cpu")
    for rec in s.rounds("ddsra"):
        if rec.inflight > 0 or rec.buffer_fill > 0:
            break
    assert s.engine._pending or s.engine._buffer
    s.restart()
    assert not s.engine._pending and not s.engine._buffer
    assert s.engine._version == 0 and s.engine._seq == 0
    s.reset()
    replay = list(s.rounds("ddsra"))
    fresh = list(sim.Simulation(sc, device="cpu").rounds("ddsra"))
    _assert_records(replay, fresh)


def test_fused_rounds_refuse_with_the_reference_message():
    """The buffered engine has no fused loop: ``fused_rounds`` raises the
    reference's message before any stream is drawn."""
    s = sim.Simulation(_scenario(rounds=2), device="cpu")
    rng0 = s.net.rng.bit_generator.state
    with pytest.raises(NotImplementedError) as got:
        s.fused_rounds()
    with pytest.raises(NotImplementedError) as want:
        ref_sim.Simulation(_ref_scenario(rounds=2)).fused_rounds()
    assert str(got.value) == str(want.value)
    assert s.t == 0 and s.net.rng.bit_generator.state == rng0


# ---------------------------------------------------------------------------
# checkpoints through a partly filled buffer, within and across packages
# ---------------------------------------------------------------------------


def _head(s, held):
    """Rounds until the engine ends one holding an update where ``held``
    says: ``"buffer"``, parked in an under-full buffer, or ``"heap"``, in
    flight (a round never ends with both); returns them."""
    head = []
    for rec in s.rounds("ddsra"):
        head.append(rec)
        if (rec.buffer_fill if held == "buffer" else rec.inflight) > 0:
            break
    assert (s.engine._buffer if held == "buffer" else s.engine._pending)
    return head


SAVED = dict(FAULTED, buffer_k=3)


def test_checkpoint_resume_within_the_port(tmp_path):
    """Save mid-buffer, flush, resume: the continued rounds equal the
    uninterrupted run's bit for bit, params too."""
    sc = _scenario(**SAVED)
    full_sim = sim.Simulation(sc, device="cpu")
    full = list(full_sim.rounds("ddsra"))
    s = sim.Simulation(sc, device="cpu")
    head = _head(s, "buffer")
    s.save(tmp_path)
    s.flush()
    assert list(tmp_path.glob("engine_*.npz"))
    resumed = sim.Simulation.resume(tmp_path, device="cpu")
    assert resumed.t == len(head)
    tail = list(resumed.rounds())
    for a, b in zip(full, head + tail):
        for name in EXACT:
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert np.array_equal(a.losses, b.losses)
    for pa, pb in zip(full_sim.params, resumed.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


@pytest.mark.parametrize("held", ["buffer", "heap"])
def test_reference_checkpoint_mid_buffer_resumes_in_the_port(tmp_path, held):
    """A directory the reference saved with a non-empty buffer, or a
    non-empty heap, resumes in the port, whose continued rounds match the
    reference's own continuation."""
    r = ref_sim.Simulation(_ref_scenario(**SAVED))
    head = _head(r, held)
    r.save(tmp_path)
    r.flush()
    s = sim.Simulation.resume(tmp_path, device="cpu")
    assert s.t == r.t == len(head)
    assert [u.seq for _, _, u in sorted(s.engine._pending,
                                        key=lambda e: e[:2])] == \
        [u.seq for _, _, u in sorted(r.engine._pending,
                                     key=lambda e: e[:2])]
    assert [u.gateway for u in s.engine._buffer] == \
        [u.gateway for u in r.engine._buffer]
    _assert_records(list(s.rounds()), list(r.rounds()))
    _assert_params(_np_params(s), [jax.tree.map(np.asarray, p)
                                   for p in r.params], **TOL)


@pytest.mark.parametrize("held", ["buffer", "heap"])
def test_port_checkpoint_mid_buffer_resumes_in_the_reference(tmp_path, held):
    """The other way: the port saves with a non-empty buffer, or heap (the
    models in the reference's side-car format), the reference resumes and
    continues as the port does."""
    s = sim.Simulation(_scenario(**SAVED), device="cpu")
    head = _head(s, held)
    s.save(tmp_path)
    s.flush()
    r = ref_sim.Simulation.resume(tmp_path)
    assert r.t == s.t == len(head)
    assert r.engine._version == s.engine._version
    assert len(r.engine._pending) == len(s.engine._pending)
    assert len(r.engine._buffer) == len(s.engine._buffer)

    def held_updates(eng):
        return [u for _, _, u in sorted(eng._pending, key=lambda e: e[:2])
                ] + list(eng._buffer)
    for got, want in zip(held_updates(r.engine), held_updates(s.engine)):
        assert dataclasses.astuple(got)[:5] == dataclasses.astuple(want)[:5]
        _assert_params([jax.tree.map(np.asarray, p) for p in got.model],
                       params_to_numpy(s.plan, want.model), rtol=0, atol=0)
    _assert_records(list(r.rounds()), list(s.rounds()))
    _assert_params([jax.tree.map(np.asarray, p) for p in r.params],
                   _np_params(s), **TOL)
