"""The split-FL data plane and simulation: datasets and cohort packing,
split forward/backward, the slot-batched cohort round and the
Scenario/Engine/Simulation API."""
