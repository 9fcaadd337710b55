"""Operational tools: the collective micro-benchmark and its sweep
(:mod:`~rabit_tpu_torch.tools.speed_test`,
:mod:`~rabit_tpu_torch.tools.speed_runner`), the collective sweep over
logical ranks (:mod:`~rabit_tpu_torch.tools.ici_bench`) and the B1
variant study (:mod:`~rabit_tpu_torch.tools.kernel_experiments`)."""
