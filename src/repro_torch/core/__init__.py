"""Framework-free planning pieces copied from ``repro.core``."""
