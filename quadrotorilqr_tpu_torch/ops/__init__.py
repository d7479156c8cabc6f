"""Small dense linear algebra."""
