"""Batched device orchestration and engine selection."""
