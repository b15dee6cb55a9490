"""Multi-position decode attention on Hopper (dense slots and paged pool):
``ops`` holds the wrappers, the plain version and ``slack_report``."""
