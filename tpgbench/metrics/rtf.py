"""rtf: detector seconds of the configuration's whole stream (every APA
of it) delivered per wall second of the window."""


def read(run: dict):
    return run["delivered"] * run["batch_s"] / run["apas"] / run["window_s"]
