"""Config-group DSL: a module-level registry populated by declarative
``group`` / ``@base`` / ``@provides`` declarations, plus the ``GridParams``
grid-search marker. Behavioral contract from reference config/dsl.py:5-52.
"""

CONFIG_GROUPS = {}
_CURRENT_GROUP = None


def group(name, datasets):
    global _CURRENT_GROUP
    assert name not in CONFIG_GROUPS, f"Already exists group `{name}'"
    for dataset in datasets:
        for other in CONFIG_GROUPS.values():
            assert dataset not in other["datasets"], (
                f"Dataset `{dataset}' already registered in group `{name}'"
            )
    CONFIG_GROUPS[name] = {"datasets": list(datasets), "base_config": None, "model_configs": {}}
    _CURRENT_GROUP = name


def base(f):
    assert CONFIG_GROUPS[_CURRENT_GROUP]["base_config"] is None, "Already exists a base config"
    CONFIG_GROUPS[_CURRENT_GROUP]["base_config"] = f
    return f


def provides(*models):
    def store_and_return(f):
        assert _CURRENT_GROUP is not None, "Must register a config group first"
        for m in models:
            assert m not in CONFIG_GROUPS[_CURRENT_GROUP]["model_configs"], (
                f"Already exists model `{m}' in group `{_CURRENT_GROUP}'"
            )
            CONFIG_GROUPS[_CURRENT_GROUP]["model_configs"][m] = f
        return f

    return store_and_return


class GridParams:
    """Iterable marker for grid expansion (dsl.py:44-52)."""

    def __init__(self, *values):
        self.values = values

    def __iter__(self):
        return iter(self.values)

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(str(v) for v in self.values)})"
