"""The shard-parallel mesh step: commits, LogUp, quotient and FRI folds over
a ('shard', 'col') grid of devices (``kernels.make_multichip_step``)."""
