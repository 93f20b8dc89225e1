"""Kernel selection: the tuning pipeline, the measured H100 tables and the runtime."""
