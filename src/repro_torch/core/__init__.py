"""Federation core: config, detection decode, the serving plane."""
