"""Router, expert library and routing objective."""
