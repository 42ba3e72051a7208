"""On-card tools of the port: `verify_device` (the kernels' identity
checks) and `bench_device` (the kernels' throughput), twins of sla_tpu's
tools/verify_device.py and tools/bench_device.py. Run each with
`python -m sla_tpu_torch.tools.<name>` on a machine with an NVIDIA GPU."""
