"""Model families (config, layers, serving hooks, registry) and
ResNet-50, the paper's workload."""
