# Importing these modules registers the config groups (side-effect registry,
# matching the reference's config/__init__ behaviour, config.py:5).
from . import two_d, tabular, images  # noqa: F401
