"""Operation counts, one module per configuration family (a configuration's ``family``)."""
