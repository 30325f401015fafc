"""Checkpoint and resume in the port: ``Simulation.save``/``flush``/
``resume`` and ``repro_torch.checkpoint.store``, held to the reference's
own contract (``tests/test_sim.py``): a run checkpointed at round t and
resumed matches an uninterrupted run record for record and bit for bit,
params included. The files are the reference's format, so a directory
written by either package resumes in the other; those continued runs agree
with the writer's own at the f32 contract (decisions and queues
bit-identical; losses and params at atol = rtol = 1e-5; accuracy to one
image in a thousand).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import dataclasses  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.fl import sim as ref_sim  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.schedulers import make_policy  # noqa: E402
from repro_torch.fl import sim  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _scenario(**kw):
    base = dict(model="mlp", rounds=4, eval_every=2, seed=0,
                max_dataset=400, k_iters=2, sigma_samples=2)
    base.update(kw)
    return base


def _sim(**kw):
    return sim.Simulation(sim.Scenario(**_scenario(**kw)), device="cpu")


def _records_equal(a, b):
    assert a.t == b.t and a.delay == b.delay and a.failures == b.failures
    assert a.cum_delay == b.cum_delay and a.accuracy == b.accuracy
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(a.queues, b.queues)
    np.testing.assert_array_equal(a.losses, b.losses)
    np.testing.assert_array_equal(a.l_n, b.l_n)


def _params_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("engine,policy", [("cohort", "random"),
                                           ("sequential", "ddsra")])
def test_checkpoint_resume_bit_identical(engine, policy, tmp_path):
    """A run checkpointed at round t and resumed matches an uninterrupted
    run record-for-record, including the final parameters."""
    uninterrupted = _sim(rounds=6, eval_every=3, engine=engine)
    full = list(uninterrupted.rounds(policy))

    s = _sim(rounds=6, eval_every=3, engine=engine)
    it = s.rounds(policy)
    head = [next(it) for _ in range(3)]
    s.save(tmp_path)
    s.flush()          # save() is non-blocking by default
    resumed = sim.Simulation.resume(tmp_path, device="cpu")
    assert resumed.t == 3
    tail = list(resumed.rounds())        # keeps the restored policy
    assert len(head) + len(tail) == len(full)
    assert any(r.trained for r in tail)
    for a, b in zip(full, head + tail):
        _records_equal(a, b)
    _params_equal(uninterrupted.params, resumed.params)


def test_resume_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        sim.Simulation.resume(tmp_path, device="cpu")


def test_save_keep_last_rotates_and_resumes(tmp_path):
    """Per-round saving with ``keep_last`` keeps disk bounded (both the
    ``step_*`` param files and the ``sim_*`` manifests) and the run still
    resumes bit-identically from the newest surviving checkpoint."""
    sc = sim.Scenario(**_scenario(rounds=5, keep_last=2))
    assert sim.Scenario.from_json(sc.to_json()).keep_last == 2

    uninterrupted = sim.Simulation(sc, device="cpu")
    full = list(uninterrupted.rounds("round_robin"))

    s = sim.Simulation(sc, device="cpu")
    it = s.rounds("round_robin")
    for _ in range(3):
        next(it)
        s.save(tmp_path)                     # keep_last from the Scenario
    s.flush()
    npz = sorted(f.name for f in tmp_path.glob("step_*.npz"))
    manifests = sorted(f.name for f in tmp_path.glob("sim_*.json"))
    assert npz == ["step_00000002.npz", "step_00000003.npz"]
    assert manifests == ["sim_00000002.json", "sim_00000003.json"]

    resumed = sim.Simulation.resume(tmp_path, device="cpu")
    assert resumed.t == 3
    tail = list(resumed.rounds())
    for a, b in zip(full[3:], tail):
        _records_equal(a, b)
    _params_equal(uninterrupted.params, resumed.params)


def test_resume_skips_stats_estimation_and_matches(tmp_path):
    s = _sim()
    next(s.rounds("ddsra"))
    s.save(tmp_path)
    s.flush()
    resumed = sim.Simulation.resume(tmp_path, device="cpu")
    assert resumed.stats_seconds < s.stats_seconds / 10
    for f in dataclasses.fields(s.stats):
        got, want = getattr(resumed.stats, f.name), getattr(s.stats, f.name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resumed.gamma, s.gamma)
    np.testing.assert_array_equal(resumed.phi, s.phi)


def test_resume_with_custom_policy_refuses_silent_swap(tmp_path):
    """A checkpoint taken under an unregistered policy instance must not
    silently continue with the scenario default."""
    class Greedy:
        def schedule(self, ctx):
            return make_policy("round_robin").schedule(ctx)

    s = _sim()
    it = s.rounds(Greedy())
    next(it)
    s.save(tmp_path)
    s.flush()
    resumed = sim.Simulation.resume(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="custom policy"):
        next(resumed.rounds())
    # passing the policy explicitly continues fine
    recs = list(resumed.rounds(Greedy()))
    assert [r.t for r in recs] == [1, 2, 3]


def test_save_snapshots_params_before_returning(tmp_path):
    """A non-blocking save writes the params as they were when ``save``
    returned, even if they change in place before the writer runs."""
    s = _sim()
    next(s.rounds("ddsra"))
    want = params_to_numpy(s.plan, s.params)
    s._ckpt_writer = sim._CheckpointWriter()
    gate = threading.Event()
    s._ckpt_writer.submit(gate.wait)         # the writer waits behind this
    s.save(tmp_path)
    for p in s.params:
        for v in p.values():
            v.add_(1.0)
    gate.set()
    s.flush()
    got = store.load_pytree(tmp_path / "step_00000001.npz", want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_store_matches_the_reference_format(tmp_path):
    """The same tree saved by both stores gives the same keys, arrays and
    dtype manifest (bf16 as uint16 views; keys with "/" escaped), and each
    store reads the other's file."""
    rng = np.random.default_rng(0)
    tree = [{"w": rng.normal(size=(3, 2)).astype(np.float32),
             "b": rng.normal(size=(2,)).astype(np.float32)}, {},
            {"attn": {"wq": rng.normal(size=(4,)).astype(np.float32)},
             "a/b": np.arange(3, dtype=np.int32), "h": rng.normal(size=(2, 2))
             .astype(np.float32)}]
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree[2]["h"] = jtree[2]["h"].astype(jnp.bfloat16)
    ttree = jax.tree.map(torch.from_numpy, tree)
    ttree[2]["h"] = ttree[2]["h"].bfloat16()
    fp = store.save_pytree(tmp_path / "port", ttree, step=1)
    fr = ref_store.save_pytree(tmp_path / "ref", jtree, step=1)
    a, b = np.load(fp), np.load(fr)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert json.loads(fp.with_suffix(".json").read_text()) == \
        json.loads(fr.with_suffix(".json").read_text())
    back = store.load_pytree(fr, ttree)
    assert back[2]["h"].dtype == torch.bfloat16
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ttree)):
        assert torch.equal(x, y)
    for x, y in zip(jax.tree.leaves(ref_store.load_pytree(fp, jtree)),
                    jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

CROSS = _scenario(rounds=3, eval_every=3)


def _records_agree(got, want):
    assert len(got) == len(want) and any(r.trained for r in got)
    for g, w in zip(got, want):
        assert g.t == w.t and g.trained == w.trained
        np.testing.assert_array_equal(g.selected, w.selected)
        np.testing.assert_array_equal(g.queues, w.queues)
        assert g.delay == w.delay and g.cum_delay == w.cum_delay
        np.testing.assert_allclose(g.losses, w.losses, **TOL)
        assert (g.accuracy is None) == (w.accuracy is None)
        if w.accuracy is not None:
            assert abs(g.accuracy - w.accuracy) <= 1e-3


def _port_params_close(port_sim, ref_params):
    for g, w in zip(params_to_numpy(port_sim.plan, port_sim.params),
                    ref_params):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_port_resumes_a_reference_checkpoint(tmp_path):
    r = ref_sim.Simulation(ref_sim.Scenario(**CROSS))
    it = r.rounds("random")
    next(it)
    r.save(tmp_path)
    r.flush()
    want = list(it)
    s = sim.Simulation.resume(tmp_path, device="cpu")
    assert s.t == 1 and s.rng.bit_generator.state == \
        ref_sim.Simulation.resume(tmp_path).rng.bit_generator.state
    _records_agree(list(s.rounds()), want)
    _port_params_close(s, r.params)


def test_reference_resumes_a_port_checkpoint(tmp_path):
    r = ref_sim.Simulation(ref_sim.Scenario(**CROSS))
    s = sim.Simulation(sim.Scenario(**CROSS), r.stats, device="cpu",
                       init_params=jax.tree.map(np.asarray, r.params))
    s.rng.bit_generator.state = r.rng.bit_generator.state
    it = s.rounds("random")
    next(it)
    s.save(tmp_path)
    s.flush()
    want = list(it)
    resumed = ref_sim.Simulation.resume(tmp_path)
    assert resumed.t == 1
    _records_agree(want, list(resumed.rounds()))
    _port_params_close(s, resumed.params)


def test_port_resumes_a_reference_ddsra_jax_checkpoint(tmp_path):
    """F8: a checkpoint the reference saved under its policy for scale,
    ``ddsra_jax``, resumes in the port, whose batched control plane then
    decides the next round as the reference's does (selected, trained and
    cuts identical, queues bit-identical, delay within 1e-6)."""
    r = ref_sim.Simulation(ref_sim.Scenario(**CROSS))
    it = r.rounds("ddsra_jax")
    next(it)
    r.save(tmp_path)
    r.flush()
    want = next(it)
    s = sim.Simulation.resume(tmp_path, device="cpu")
    assert s.t == 1 and s._policy.name == "ddsra_jax"
    assert s._policy.device == s.device
    got = next(s.rounds())
    assert got.t == want.t and got.trained == want.trained
    np.testing.assert_array_equal(got.selected, want.selected)
    np.testing.assert_array_equal(got.l_n, want.l_n)
    np.testing.assert_array_equal(got.queues, want.queues)
    assert abs(got.delay - want.delay) <= 1e-6
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
