"""Analysis of a finished run: the scene export (``scene_export``), the
``--viz`` keyframe overlays and report (``overlays``), and the plot CLIs
over the telemetry CSV (``plot_timing_breakdown``, ``plot_feature_metrics``,
``plot_detector_comparison``, styled by ``style``).

The reference's five names (``PALETTE``, ``apply_style`` and the three plot
mains) are exported lazily: this package imports none of its modules until
one of them is asked for, so it imports without matplotlib; only ``style``
and the plot mains need it.
"""

import importlib
import sys
import types

_LAZY = {
    "PALETTE": ("style", "PALETTE"),
    "apply_style": ("style", "apply_style"),
    "plot_timing_breakdown": ("plot_timing_breakdown", "main"),
    "plot_feature_metrics": ("plot_feature_metrics", "main"),
    "plot_detector_comparison": ("plot_detector_comparison", "main"),
}

__all__ = sorted(_LAZY)


class _Package(types.ModuleType):
    """Resolves the five names on each access, also after their module has
    been imported (an import binds the module's own name on the package;
    the reference's eager imports bind the main there instead)."""

    def __getattribute__(self, name):
        if name in _LAZY:
            module, attr = _LAZY[name]
            return getattr(importlib.import_module(f"{__name__}.{module}"), attr)
        return super().__getattribute__(name)


sys.modules[__name__].__class__ = _Package
