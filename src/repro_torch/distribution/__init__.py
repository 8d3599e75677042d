"""Distribution: the logical sharding rules (`sharding`), every
cross-rank collective (`collectives`: the sharded step's gathers and
reductions, the int8 ring, the bucketed psum, and the near-memory merge
of a sharded page arena) and the GPipe pipeline (`pipeline`)."""
from repro_torch.distribution.sharding import (
    AxisRules,
    DEFAULT_RULES,
    use_mesh,
    use_rules,
    current_mesh,
    current_rules,
    logical_to_spec,
    with_logical_constraint,
    named_sharding,
    param_shardings,
)
