"""One driver per entry point of the program; a traffic mix names its own."""
