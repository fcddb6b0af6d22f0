"""``loop.steps_per_s``: the training loop's own ``steps_per_sec`` (a host clock over one
epoch's steps, ending in the read of its loss), median of the window's eval epochs."""
import statistics


def read(r):
    records = [x["steps_per_sec"] for x in r.facts.get("records", ())]
    return statistics.median(records) if r.facts.get("kind") == "train" and records else None
