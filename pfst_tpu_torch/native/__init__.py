"""Native (C++) host-side kernels of the data pipeline (``hostaug``),
built with g++ at first use."""
from . import hostaug  # noqa: F401
