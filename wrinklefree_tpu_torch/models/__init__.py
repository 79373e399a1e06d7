"""Model parameters and head."""
