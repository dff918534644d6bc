"""Framework-neutral NumPy vocabulary (chunk plans, architecture names)."""
