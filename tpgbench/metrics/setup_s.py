"""setup_s: process start to the first measured batch (imports, CUDA
start, traffic made on the device, builds on a checkout's first run,
warm-up batches)."""


def read(run: dict):
    return run["setup_s"]
