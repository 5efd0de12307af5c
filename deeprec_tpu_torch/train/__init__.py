"""The Trainer, its metrics, and the forward conventions shared by training
and serving."""
