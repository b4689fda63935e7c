"""The yardstick's arithmetic, frozen: the work a call needs, counted from
the configuration's shapes, and the card's published peaks."""
