"""Distribution: the near-memory merge of a sharded page arena
(`collectives.combine_shard_partials`).  The logical sharding rules of
training (the reference's `distribution/sharding.py`, re-exported here
there) wait for sharded training (ROADMAP.md queue A, A.6 part two)."""
