"""Run utilities: phase timing and tracing, metrics logs, checkpoints and
texture exports."""
