"""``ce_roofline.train``: ``readings.ce_roofline`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.ce_roofline(record, "train")
