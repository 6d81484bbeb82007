"""Model configurations."""
