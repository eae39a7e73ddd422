"""The frozen astrophysics: spin temperature, ionization and their host tables."""
