"""``fetch_wait_ms.train``: ``readings.fetch_wait_ms`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.fetch_wait_ms(record, "train")
