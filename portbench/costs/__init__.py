"""Work counts and the card's peaks behind the roofline shares."""
