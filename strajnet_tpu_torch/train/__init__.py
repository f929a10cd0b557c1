"""The predict step."""
