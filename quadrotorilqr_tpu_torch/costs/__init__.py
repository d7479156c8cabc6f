"""Cost functions."""
