"""``enqueue_ms.train``: ``readings.enqueue_ms`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.enqueue_ms(record, "train")
