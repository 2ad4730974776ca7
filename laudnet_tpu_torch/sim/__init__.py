"""The latency models of the port: the H100's peaks and measured rates
(`hardware.HopperSpec`), the model of the port's execution forms on it
(`h100`) and the planner that ranks them (`plan`); and the reference's GPU
roofline simulator (`hardware.DeviceSpec` and its five presets, `roofline`,
`dynamic`, `transformer`, `adavit`, `models.predict_network`, the `cli`),
with copies of the JAX package's report, tile and geometry helpers."""
