"""Configurations the port needs: the imagery pipeline and the
inter-region table.  The LM architecture configs come with the LM stack."""
