"""Run telemetry the serving layer reports through: the metrics registry
(:mod:`.registry`) and its Prometheus rendering (:mod:`.exporter`), host
spans (:mod:`.spans`), the flight recorder (:mod:`.flight`, with the
compile-event log it taps, :mod:`.compile`) and the device-memory sampler
(:mod:`.device`). Copies of the JAX package's stdlib modules, apart from
the sampler, which reads the card through PyTorch. The watchdog,
profiler, report and aggregation modules wait for ROADMAP A15."""
