"""Single-file aggregation-rule plugins.

Port of ``repro/core/rules/``.  Each module here defines ONE rule: an
``AggregatorRule`` subclass decorated with ``@register_rule``.  Every module
in this package is imported automatically (below), and the registry imports
this package on any lookup, so dropping a new file here is all the wiring a
rule needs.  ``mediam.py`` is the template.
"""
import importlib
import pkgutil

for _mod in pkgutil.iter_modules(__path__):
    importlib.import_module(f"{__name__}.{_mod.name}")
del importlib, pkgutil, _mod
