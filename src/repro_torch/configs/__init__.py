"""Architecture configurations (the repository model the engine calls)."""
