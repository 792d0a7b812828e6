"""The benchmark harness of cora_tpu_torch: finds a cell's configuration,
traffic, entry and metric readers by name, runs the measured window and
prints the one result line."""
