"""Spark DataFrame -> cached Parquet -> the card, through the converter."""
