"""Fleet engine, staging and the dispatch seam."""
