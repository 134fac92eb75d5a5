# Deliberately-violating servelint fixtures (protolint / conclint /
# determlint). Excluded from the clean-tree walk like the rest of
# graphlint_fixtures; linted explicitly by tests/test_servelint.py.
