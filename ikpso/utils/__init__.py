"""Runtime utilities: configs, diagnostics, checkpointing, profiling."""

from ikpso.utils.configio import RunConfig, dump_config, load_config
from ikpso.utils.diagnostics import DiagnosticsWriter, SolveLogger
