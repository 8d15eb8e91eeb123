"""``device_idle.train``: ``readings.device_idle`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.device_idle(record, "train")
