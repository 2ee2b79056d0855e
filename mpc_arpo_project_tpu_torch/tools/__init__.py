"""Tools of the port that run on the card: the chunk-parts timing probe."""
