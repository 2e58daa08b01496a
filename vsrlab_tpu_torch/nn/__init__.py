"""Conv building blocks of the port."""
