"""Batched device orchestration over the devices of a host and the
processes of a run, and engine selection."""
