"""A metric that exists only under the tests: rows a unit of the window."""

LAYER = "loader"
UNIT = "rows"
MOVES = "train_samples_per_s"


def read(record):
    window = record["window"]
    return window["samples"] / window["units"] if window["units"] else None
