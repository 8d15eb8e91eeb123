"""``model_device_ms.train``: ``readings.model_device_ms`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.model_device_ms(record, "train")
