"""train.device_idle: the share of the traced window in which no kernel, copy
or set ran on the card (torch.profiler's device events), in %."""

from benchmark.readers import idle_percent


def read(run):
    return idle_percent(run)
