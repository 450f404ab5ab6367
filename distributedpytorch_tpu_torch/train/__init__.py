"""The serving-side predict step."""
