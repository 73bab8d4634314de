"""launches_per_batch: kernel records on the device a batch (the TPG
kernel, the compaction's steps, any device unpack; copies and memsets
out), from the traced segment."""


def read(run: dict):
    tr = run.get("trace")
    if not tr or not tr["batches"] or not tr["busy_s"] or "kernels" not in tr:
        return None
    return tr["kernels"] / tr["batches"]
