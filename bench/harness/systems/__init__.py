"""One driver per kind of system under test, named by a configuration's
``system``."""
