"""CTR and sequence (DIN, DIEN) models and their layers."""
