"""The paper's figure computations (``figures``), their matplotlib panels
(``plots``) and the figure notebooks' pickle formats (``notebook_data``).

Counterpart of ``b2txt_tpu/analysis/__init__.py``, with the same names. The
``plot_*`` names resolve when first used, so the package imports without
matplotlib; calling one without matplotlib raises matplotlib's own
``ImportError``.
"""

from .figures import (
    cumulative_usage,
    logit_raster,
    per_day_error_rates,
    vocab_condition_comparison,
    words_per_minute,
)
from .notebook_data import (
    copy_task_error_rates,
    export_copy_task_pickle,
    personal_use_summary,
    render_figure_2,
    render_figure_4,
)

_PLOTS = (
    "plot_correctness_by_day",
    "plot_correctness_pie",
    "plot_cumulative_usage",
    "plot_error_rates_by_day",
    "plot_logit_raster",
    "plot_wpm_by_day",
)


def __getattr__(name):
    if name in _PLOTS:
        from . import plots

        return getattr(plots, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
