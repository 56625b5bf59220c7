"""Workloads that the operator's end-to-end tests launch as pods."""
