"""Host-side CLI tools.

- ``create_fixtures``: regenerate the committed serialization fixtures in
  tests/fixtures/.
"""
