"""The synthetic, restart-safe LM data pipeline (numpy only)."""
