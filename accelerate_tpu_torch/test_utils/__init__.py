"""Test helpers of the PyTorch port: the install check `test_script` and the multi-process scripts it chains."""
