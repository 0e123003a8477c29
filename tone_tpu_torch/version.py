"""Package version."""

VERSION = "0.1.0"
