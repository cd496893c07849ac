"""File IO."""
