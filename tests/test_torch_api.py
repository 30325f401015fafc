"""F12: every package of the port exports the reference package's public
names (``__all__``), from the port's own modules.

Every package holds all of the reference's names. ``NOT_YET`` would list
the names of a ROADMAP.md item not ported yet, each with its item, and
the port must still lack them (a name that arrives leaves the list); it
is empty since ``core.partition`` (M11c) and ``sharding``'s
``DEFAULT_RULES``, ``partition_specs`` and ``rules_for_mesh`` (M11d)
arrived. A reference name whose counterpart has another name in the port
is listed with it.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    # the reference imports this alias, which JAX 0.9 dropped; patched for
    # this process only
    jax.experimental.enable_x64 = lambda v=True: jax.enable_x64(v)

import importlib  # noqa: E402

import pytest  # noqa: E402

# reference name -> the ROADMAP.md item that ports it: none left since
# M11c (core.partition) and M11d (the sharding rules) were ported
NOT_YET = {}
# reference name -> the port's counterpart under another name
RENAMED = {
    "core": {"ddsra_jax": "ddsra_batched"},    # registered as "ddsra_jax"
    # jax PartitionSpecs of the cohort mesh: the port splits slots by
    # CohortMesh.block and replicates the rest
    "sharding": {"SLOT_SPEC": "CohortMesh", "STACKED_SLOT_SPEC": "CohortMesh",
                 "REPLICATED": "CohortMesh"},
}
PACKAGES = ["fl", "checkpoint", "core", "models", "configs", "sharding"]


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_exports_the_reference_names(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    not_yet = NOT_YET.get(package, {})
    renamed = RENAMED.get(package, {})
    want = set(ref.__all__)
    assert set(not_yet) <= want and set(renamed) <= want
    for name in sorted(want - set(not_yet)):
        assert hasattr(port, renamed.get(name, name)), (package, name)
    for name, item in not_yet.items():
        assert item in ("M11c", "M11d") and not hasattr(port, name), (
            package, name)
    if package in ("fl", "checkpoint", "models", "configs"):
        assert not not_yet and not renamed
        assert set(ref.__all__) <= set(dir(port))
        assert set(port.__all__) == set(ref.__all__)


def test_documented_entry_point_imports():
    """``README.md``'s line against the port, and the engines it
    registers on import, as the reference's package does."""
    from repro_torch.fl import Scenario, Simulation, ShardedCohortEngine
    from repro_torch.fl import sim
    assert Scenario().engine in sim.ENGINES
    assert sim.ENGINES["sharded"] is ShardedCohortEngine
    assert {"cohort", "sharded", "async", "sequential"} == set(sim.ENGINES)
    assert Simulation.__module__ == "repro_torch.fl.sim"
