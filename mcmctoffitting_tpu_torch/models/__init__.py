"""Forward models and fit problems of the port."""
