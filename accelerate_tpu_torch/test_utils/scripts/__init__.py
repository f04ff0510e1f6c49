"""Multi-process assertion scripts that `test_utils.test_script` chains at two processes."""
