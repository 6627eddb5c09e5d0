"""Analysis of a finished run: the scene export (``scene_export``), the
``--viz`` keyframe overlays and report (``overlays``), and the plot CLIs
over the telemetry CSV (``plot_timing_breakdown``, ``plot_feature_metrics``,
``plot_detector_comparison``, styled by ``style``).

Unlike the reference's, this package imports none of its modules, so it
imports without matplotlib; only ``style`` and the plot mains need it.
"""
