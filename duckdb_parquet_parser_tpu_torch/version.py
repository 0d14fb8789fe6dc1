__version__ = "0.5.0"  # the reference release this port follows
