"""Training infrastructure of the port: losses, metrics, schedules, the
config system, checkpoints and loggers."""
