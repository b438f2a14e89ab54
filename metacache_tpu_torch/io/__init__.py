from . import sequence_io, taxonomy_io  # noqa: F401
