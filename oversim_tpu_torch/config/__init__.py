"""ini front end: ``ini.py`` (the parser) and ``scenario.py`` (the builder)."""
