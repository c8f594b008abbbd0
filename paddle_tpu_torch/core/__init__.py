"""Device resolution and dtypes."""
