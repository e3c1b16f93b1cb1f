"""Graph-WFA on the device: the banded DP kernel and its host side."""
