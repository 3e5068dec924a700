"""The repository model the serving engine calls: a dense decoder LM."""
