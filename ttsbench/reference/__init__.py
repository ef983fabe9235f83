"""The plain float32 reference that `correct` is judged against."""
