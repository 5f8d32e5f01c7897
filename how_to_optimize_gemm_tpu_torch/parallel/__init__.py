"""Serving: the continuous-batching engine over the model's decode step."""
