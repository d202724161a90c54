"""The Byzantine-resilient synchronous-SGD train step."""
