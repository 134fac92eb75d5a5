# Deliberate-violation fixtures for the port's analysis tests
# (tests/test_torch_graphlint.py, test_torch_servelint.py,
# test_torch_flowlint.py). The directory name contains
# 'graphlint_fixtures', so both packages' analyzers skip it in their
# default scans (astlint.iter_python_files); each file seeds exactly the
# regression its rule must catch, and the tests lint it by name.
