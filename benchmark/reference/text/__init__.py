"""The reference's text frontend: frozen copies of the port's plain text
modules (normalization, segmentation, lexicon, tone sandhi, English G2P,
G2P with prosody) and a plain BERT scorer."""
