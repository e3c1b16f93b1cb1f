"""Version stamping (ref: cli.rs:13-19, build.rs:4-19 use vergen git describe)."""

import subprocess

__version__ = "0.1.0"


def full_version() -> str:
    """Crate version + git describe, like the reference's FULL_VERSION."""
    try:
        desc = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 2)[0],
        ).stdout.strip()
    except Exception:
        desc = ""
    return f"{__version__}-{desc}" if desc else __version__
