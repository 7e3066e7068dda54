"""Sharding: logical-axis rules mapping models onto device meshes."""
from .rules import (active, constrain, default_rules, param_shardings,
                    placements_for, spec_for, use_rules)

__all__ = ["active", "constrain", "default_rules", "param_shardings",
           "placements_for", "spec_for", "use_rules"]
