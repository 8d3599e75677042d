"""Dense transformer family: config, layers, paged hooks, registry."""
