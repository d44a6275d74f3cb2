"""The benchmark's frozen counts: published peaks of the card, a step's
analytic training FLOPs, and K3's roofline bound."""
