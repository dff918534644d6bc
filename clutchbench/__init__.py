"""The benchmark of ``repro_torch``: cells, their inputs and traffic, the
plain reference and the yardstick.  ``run.py`` runs one cell once."""
