"""Entry-point launchers."""
