"""HDF5 files of output boxes (`h5`) and the on-disk output cache (`caching`).
Both need the optional h5py, imported only when a file is read or written."""
