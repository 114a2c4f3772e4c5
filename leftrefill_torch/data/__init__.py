"""The training data path (counterpart of ``leftrefill_tpu/data``): image
files and operations without OpenCV or PIL (``image_io``, ``jpeg``), the
training masks (``masks``), the datasets (``datasets``), the MegaDepth pair
preprocessors (``preprocess``) and the loader (``loader``)."""

from leftrefill_torch.data.loader import flatten_views  # noqa: F401
