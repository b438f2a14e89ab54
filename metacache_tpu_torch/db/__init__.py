from .database import Database, shard_path  # noqa: F401
from .feature_table import FeatureTable  # noqa: F401
from .taxonomy import Rank, Taxonomy, rank_from_name, rank_name  # noqa: F401
