"""Kernel-selection runtime."""
