"""Window loops, one file a traffic kind (`traffic/<mix>.json`'s `kind`)."""
