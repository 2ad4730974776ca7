"""The latency model and planner of the port's serving engine: the H100's
peaks and measured rates (`hardware`), the model of the port's execution
forms on it (`h100`), and the planner that ranks them (`plan`), with copies
of the JAX package's report, tile and geometry helpers."""
