"""L2 model-family registry of the port and ``run_model``, the one-call
execution over a (T, C) stream (copy of ``fdreadoutlibs_tpu/models``)."""

from .algorithms import MODEL_FAMILIES, get_model, run_model  # noqa: F401
